from .simulate import SimDataset, SimRead, paf_rows, read_truth_arrays, simulate, true_sequence
from .labels import read_labels, window_labels
from .train import TrainBatch, Trainer, make_optimizer, make_train_step
from .data import LabelledWindow, batch_iterator, collate_train, simulated_windows

__all__ = [
    "SimDataset",
    "SimRead",
    "paf_rows",
    "read_truth_arrays",
    "simulate",
    "true_sequence",
    "read_labels",
    "window_labels",
    "TrainBatch",
    "Trainer",
    "make_optimizer",
    "make_train_step",
    "LabelledWindow",
    "batch_iterator",
    "collate_train",
    "simulated_windows",
]
