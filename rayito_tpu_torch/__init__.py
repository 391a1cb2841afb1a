"""rayito_tpu_torch — the PyTorch + CUDA port of rayito_tpu for NVIDIA
Hopper GPUs.

Each module mirrors its ``rayito_tpu`` counterpart's path and public names
(``render/pallas_traverse.py`` becomes ``render/traverse.py``); the TPU's
Pallas kernels become hand-written CUDA C++ under ``csrc/``, built with
``nvcc`` at first use. The package imports torch and numpy only.
"""

__version__ = "0.1.0"

from .models.camera import PerspectiveCamera  # noqa: F401
from .models.scene import (  # noqa: F401
    DiffuseMaterial,
    EmitterMaterial,
    GlossyMaterial,
    Plane,
    RectangleLight,
    ReflectionMaterial,
    Scene,
    SceneData,
    ShapeLight,
    Sphere,
    Transform,
    TriangleMesh,
)
from .utils.config import RenderConfig  # noqa: F401
