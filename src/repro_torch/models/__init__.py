"""The LM side: configs, layers, blocks, model assembly and serve steps
(the port of the reference's ``models/``; the dense family so far)."""
