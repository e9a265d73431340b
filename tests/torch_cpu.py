"""One intra-op thread for torch's CPU kernels in the port's tests.

The tier-1 run spreads the test files over six pytest-xdist workers on
an eight-core host. At torch's default (one intra-op thread per core)
each worker's CPU engine spins eight threads, and six such workers ran
the engine byte gates 20-40x slower than alone. One thread a worker
keeps the run inside its time limit. Every byte gate of the port's
tests passes at this count.

Every ``tests/test_torch_*.py`` imports this module first. pytest-xdist
workers import every test module when they collect, so the cap holds for
the whole worker process, the JAX tests that run torch included.
"""

import torch

THREADS = 1

torch.set_num_threads(THREADS)
