from .wave import read_wave, write_wave

__all__ = ["read_wave", "write_wave"]
