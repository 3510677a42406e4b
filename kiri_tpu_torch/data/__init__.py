"""Host-side data of the port: Khmer reordering, the line datasets of
training and the detectors' ground truth."""
