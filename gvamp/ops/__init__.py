from gvamp.ops.layout import PlanarLayout
from gvamp.ops import decode, matvec, special

__all__ = ["PlanarLayout", "decode", "matvec", "special"]
