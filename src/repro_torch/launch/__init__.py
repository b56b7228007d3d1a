"""Launch layer: the LM serving loop (:mod:`.serve`), the training
entry point (:mod:`.train`) and the data mesh of sharded search plans
(:mod:`.mesh`)."""
