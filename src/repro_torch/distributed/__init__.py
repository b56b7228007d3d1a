"""Training-runtime substrate: fault recovery, stragglers, compression
(the port of the reference's ``distributed/``, for one process).

* `recovery`    — step-loop supervisor: failure detection (exceptions, NaN
  loss, simulated chip failures), restore from the newest checkpoint with
  bounded retries.
* `straggler`   — per-step deadline monitor (median + MAD outlier
  detection) with slow-step logging and a rebalancing hint.
* `compression` — error-feedback gradient compressors (int8 quantization /
  top-k sparsification) applied to the gradient tree before the optimizer.
"""

from .compression import (CompressionState, ErrorFeedbackInt8,
                          ErrorFeedbackTopK, NoCompression)
from .recovery import RecoveryConfig, SimulatedFailure, Supervisor
from .straggler import StragglerMonitor

__all__ = ["CompressionState", "ErrorFeedbackInt8", "ErrorFeedbackTopK",
           "NoCompression", "RecoveryConfig", "Supervisor",
           "SimulatedFailure", "StragglerMonitor"]
