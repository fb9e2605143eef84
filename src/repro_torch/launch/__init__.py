"""Launching training: the batch stand-ins, the elastic mesh arithmetic,
restart planning and heartbeats, and the training launcher
(``python -m repro_torch.launch.train``)."""
