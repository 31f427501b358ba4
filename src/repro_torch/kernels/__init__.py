"""Hand-written CUDA kernels of the port (built at first use).

* `repro_torch.kernels.timing_scan` -- the schedule-IR timing recurrence
  (``csrc/timing_scan.cu``), with its plain torch version and launch count.
* `repro_torch.kernels.flash_attention` -- blocked online-softmax
  attention (``csrc/flash_attention.cu``), with its plain torch version,
  launch count and the model-layout wrapper.
* `repro_torch.kernels.ssd_scan` -- the Mamba2 SSD chunked scan
  (``csrc/ssd_scan.cu``), with its plain torch version, launch count and
  the model-layout wrapper.
"""
