"""Launch layer: the LM serving and training launchers
(:mod:`repro_torch.launch.serve`, :mod:`repro_torch.launch.train`), the
step factories they share (:mod:`repro_torch.launch.steps`), meshes and
the shardings the binding rules give on them
(:mod:`repro_torch.launch.mesh`, :mod:`repro_torch.launch.shardings`),
and the machine constants of the card the port serves on
(:mod:`repro_torch.launch.roofline`), which the tuner's dry cost model
reads."""
