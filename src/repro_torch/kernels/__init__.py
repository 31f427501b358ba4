"""Hand-written CUDA kernels of the port (built at first use).

* `repro_torch.kernels.timing_scan` -- the schedule-IR timing recurrence
  (``csrc/timing_scan.cu``), with its plain torch version and launch count.
"""
