"""Host utilities of the port: page image reading, stage timing, the ONNX
wire codec and graph interpreter, and Khmer grapheme clusters."""
