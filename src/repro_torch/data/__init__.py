# Copied from src/repro/data/__init__.py; only the repro. imports are rewritten.
from repro_torch.data.preprocess import (  # noqa: F401
    decode_image,
    preprocess_image,
    random_crop_params,
)
from repro_torch.data.offload_prep import OffloadPrep  # noqa: F401
from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
from repro_torch.data.ingest import IngestState, PrepPipeline  # noqa: F401
