"""Array schedule IR of the port: host-side IR + device-side scoring.

* `repro_torch.core.ir.engine`   -- the IR (``ScheduleIR``, lossless
  converters, vectorized legality, CCT reductions) and the batched sweep
  packer in numpy; the greedy's water-fill/rollout primitives in torch.
* `repro_torch.core.ir.backends` -- ``TorchBackend``, which runs the
  timing recurrence (`repro_torch.kernels.timing_scan`) on a device.
"""

from repro_torch.core.ir.backends import (
    TimingBackend,
    TorchBackend,
    backend_on,
    pad_packed,
)
from repro_torch.core.ir.engine import (
    _BIG,
    KIND_RECFG,
    KIND_XMIT,
    NO_CONFIG,
    BatchInstance,
    BatchResult,
    IRMetrics,
    ScheduleIR,
    batch_evaluate,
    evaluate_decisions,
    execute_ir,
    fabric_arrays,
    finalize_result,
    from_ir,
    pack_instances,
    rollout_batch,
    to_ir,
    validate_ir,
    waterfill_batch,
)

__all__ = [
    "BatchInstance",
    "BatchResult",
    "IRMetrics",
    "KIND_RECFG",
    "KIND_XMIT",
    "NO_CONFIG",
    "ScheduleIR",
    "TimingBackend",
    "TorchBackend",
    "_BIG",
    "backend_on",
    "batch_evaluate",
    "evaluate_decisions",
    "execute_ir",
    "fabric_arrays",
    "finalize_result",
    "from_ir",
    "pack_instances",
    "pad_packed",
    "rollout_batch",
    "to_ir",
    "validate_ir",
    "waterfill_batch",
]
