"""Machine constants of the card the port serves on, for roofline bounds.

One NVIDIA H100 SXM5 80GB, from NVIDIA's data sheet, at the card's full
700 W power limit (a card set below it runs slower under load):

* ``PEAK_FLOPS`` — 67 TFLOP/s in float32 on the CUDA cores, outside the
  tensor cores: the rate of the fp32 FMA accumulation the port's kernels
  keep (TF32 tensor cores would change the numbers);
* ``HBM_BW`` — 3.35 TB/s of HBM3 bandwidth.

The tuner's dry cost model (``tune.evaluator.roofline_estimate_us``)
reads them.  The dry-run analysis of the reference's ``launch`` package
(HLO FLOPs, collective bytes) comes with the LM substrate.
"""

PEAK_FLOPS = 67e12         # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12           # bytes/s of HBM3
