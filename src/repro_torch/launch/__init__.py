"""Launch layer: the LM serving loop (:mod:`.serve`) and the data mesh
of sharded search plans (:mod:`.mesh`)."""
