from gvamp.io import plink, vecio

__all__ = ["plink", "vecio"]
