from .const import CONST, GRID, DATA, FACES, CENTERS, VERTICES
from .data import Dataloader, Datawriter, XDMFWriter

__all__ = ["CONST", "GRID", "DATA", "FACES", "CENTERS", "VERTICES",
           "Dataloader", "Datawriter", "XDMFWriter"]
