"""One intra-op thread for torch in each process that runs the port's CPU
tests.

The suite runs in several pytest-xdist workers on one host. Left alone,
torch starts one intra-op thread per core in every worker, so the workers'
threads outnumber the cores and spin against each other: a port run that
takes a second alone then takes a minute. Each port test module imports
this module, so the setting holds in every worker that collects one.
"""
import torch

torch.set_num_threads(1)
