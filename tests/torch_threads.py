"""Caps torch's intra-op threads in the port's CPU tests.

Tier-1 runs the suite in several pytest-xdist workers on one host. torch
starts as many intra-op threads as the host has cores in every worker, so
six workers ran 48 threads on 8 cores and CPU-heavy tests (the vocoders'
twins, the export traces) slowed down many times over. Every
``tests/test_torch_*.py`` imports this module first, which gives each
worker its share of the cores: ``cpu_count // PYTEST_XDIST_WORKER_COUNT``
(all of them in a run without xdist). Subprocesses that a test starts get
the same cap through ``OMP_NUM_THREADS`` (:data:`ENV`).
"""

import os

import torch

THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
ENV = {"OMP_NUM_THREADS": str(THREADS)}

torch.set_num_threads(THREADS)
