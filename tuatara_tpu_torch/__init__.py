"""tuatara_tpu_torch: the tuatara OCR engine (CRAFT + PARSEQ) in PyTorch
with hand-written CUDA kernels, for one NVIDIA H100.

A port of the JAX package `tuatara_tpu`, which stays in the repo as its
reference. Same entry point as the reference's Python binding:

    import tuatara_tpu_torch
    results = tuatara_tpu_torch.image_to_data(image, weights_dir)
    # [{"text": str, "bbox": [x0, y0, x1, y1], "confidence": float}]

The engine runs on the GPU unless `device="cpu"` is passed.
"""

from tuatara_tpu_torch.api import OcrEngine, image_to_data
from tuatara_tpu_torch.config import DEFAULT_CONFIG, CraftConfig, OcrConfig, ParseqConfig
from tuatara_tpu_torch.tokenizer import Tokenizer

__all__ = [
    "OcrConfig",
    "CraftConfig",
    "ParseqConfig",
    "DEFAULT_CONFIG",
    "Tokenizer",
    "OcrEngine",
    "image_to_data",
]
