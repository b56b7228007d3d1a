"""Hand-written Hopper kernels for the compute hot spots.

* `cam_search` — the paper's primitive: fused distance + block top-k,
                 float (hamming / dot / L2) and bit-packed
                 (XOR + popcount, binary or ternary); CUDA sources in
                 `csrc/`, built by `build`; plain PyTorch versions beside
                 each kernel.
* `ops`        — padding and the final stable candidate merge.
* `packing`    — 32-cell int32 lane packing and popcount.
* `ref`        — plain PyTorch oracles (the reference package's
                 `repro.kernels.ref` contract).

Importing this package builds nothing; a kernel compiles at its first
launch on a CUDA tensor.
"""
