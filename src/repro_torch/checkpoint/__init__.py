"""Persistence of the port's host-side artifacts: the stratification index
(:mod:`repro_torch.checkpoint.index_io`)."""
