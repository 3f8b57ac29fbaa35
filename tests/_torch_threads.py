"""Imported first by every port test file (pytest does not collect it):
one intra-op thread a process. The port's CPU tests run small tensors,
which gain nothing from threads, in several pytest workers at once; with
torch's default of a thread a core, the workers' threads starve each
other (a file ran 5–10× slower in the suite than alone)."""
import torch

torch.set_num_threads(1)
