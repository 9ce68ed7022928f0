from .labels import read_labels, window_labels
from .simulate import SimDataset, SimRead, paf_rows, read_truth_arrays, simulate, true_sequence
