"""Launch layer.  So far only the machine constants of the card the port
serves on (:mod:`repro_torch.launch.roofline`), which the tuner's dry cost
model reads."""
