"""``paddle.framework`` of the port: ``io`` (``save`` / ``load``)."""
from . import io  # noqa: F401
