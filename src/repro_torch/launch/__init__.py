"""Launch layer: the LM serving launcher (:mod:`repro_torch.launch.serve`)
and the machine constants of the card the port serves on
(:mod:`repro_torch.launch.roofline`), which the tuner's dry cost model
reads."""
