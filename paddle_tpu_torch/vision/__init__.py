"""``paddle.vision`` of the port (counterpart of ``paddle_tpu/vision``):
the model zoo (``models``: the ResNet family, LeNet, VGG, AlexNet,
MobileNetV2) on the port's ``nn`` layers, and the image backend switch.
``transforms``, ``datasets``, ``ops`` and the models of the JAX
package's ``vision/models/extra.py`` wait for a later slice (ROADMAP
Queue 1, item 11)."""
from . import models  # noqa: F401

__all__ = ["models", "set_image_backend", "get_image_backend",
           "image_load"]

_image_backend = "numpy"


def set_image_backend(backend: str):
    """Record the backend name (the reference's "pil" / "cv2"); images
    are decoded with numpy, and PIL where it is importable."""
    global _image_backend
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path: str, backend=None):
    """An image file as an HWC array: ``.npy`` always, an encoded image
    through PIL."""
    import numpy as np
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("image_load needs PIL for encoded images; "
                           "save arrays as .npy in this environment")
    return np.asarray(Image.open(path))
