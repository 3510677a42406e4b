"""Host-side data of the port: the synthetic line and document generators,
Khmer reordering, the line datasets of training and the detectors' ground
truth."""
from .datasets import LineSampleSet, load_local_dataset
from .synth import (DatasetGenerator, FontManager, ImageRenderer,
                    MultilingualDatasetGenerator, sample_text)

__all__ = ["DatasetGenerator", "MultilingualDatasetGenerator", "FontManager",
           "ImageRenderer", "sample_text", "LineSampleSet",
           "load_local_dataset"]
