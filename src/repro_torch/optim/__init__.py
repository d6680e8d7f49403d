from repro_torch.optim.adamw import AdamWConfig, AdamWState, init, schedule, update

__all__ = ["AdamWConfig", "AdamWState", "init", "schedule", "update"]
