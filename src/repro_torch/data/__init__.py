"""The synthetic corpus and the step-indexed data pipeline."""

from repro_torch.data.pipeline import DataPipeline, calibration_batches
from repro_torch.data.synthetic import (STREAM_CALIB, STREAM_EVAL,
                                        STREAM_TRAIN, MarkovCorpus,
                                        zipf_logits)

__all__ = ["DataPipeline", "MarkovCorpus", "STREAM_CALIB", "STREAM_EVAL",
           "STREAM_TRAIN", "calibration_batches", "zipf_logits"]
