"""Hand-written Hopper kernels for the compute hot spots.

* `cam_search` — the paper's primitive: fused distance + block top-k,
                 float (hamming / dot / L2) and bit-packed
                 (XOR + popcount, binary or ternary), and the full
                 float distance matrix; CUDA sources in `csrc/`, built
                 by `build`; plain PyTorch versions beside each kernel.
* `acam`       — analog-CAM range search: the interval match (aCAM
                 `lo <= q <= hi` cells) and the thresholded distance
                 (TH sensing), each writing a boolean match matrix;
                 plain PyTorch versions beside each kernel.
* `hdc_encode` — HDC record-based hypervector encoding: bind as XOR of
                 sign bit planes, majority bundle as bit-sliced
                 carry-save counts; plain PyTorch version beside it.
* `flash_attention` — the LM's attention forward (online softmax, GQA,
                 causal / prefix / cache-length masks), every attention
                 call of prefill, decode and the no-cache forward; plain
                 PyTorch version (the reference's ``attn_core``) beside
                 it.
* `ssd_scan`   — M1: the Mamba2 chunked SSD scan of a prefill (three
                 launches a call, no TPU counterpart: the reference's
                 ``lax.scan``); plain PyTorch version beside it.
* `slstm_scan` — X1: the sLSTM recurrence over a whole sequence in one
                 cooperative launch (the reference's ``lax.scan``);
                 plain PyTorch version beside it.
* `lm_ops`     — B7, B7b and B2 (as the MoE router) as ``torch.library``
                 custom ops with fake implementations: the LM's call
                 sites, which trace under ``FakeTensorMode``.
* `ops`        — padding, the final stable candidate merge, the range
                 entry points, the distance API (`cam_distances`,
                 `cam_exact`, `cam_range`) and the HDC algebra.
* `packing`    — 32-cell int32 lane packing and popcount.
* `ref`        — plain PyTorch oracles (the reference package's
                 `repro.kernels.ref` contract).

Importing this package builds nothing; a kernel compiles at its first
launch on a CUDA tensor.
"""
