from .vit import Mast3rModel, Mast3rConfig
from .alignment import make_pairs_logwin, global_align, estimate_focal
