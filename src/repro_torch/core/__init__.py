"""Scheduler core: dispatch engine, estimator, learner, scheduler turn."""
