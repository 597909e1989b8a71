from .model import SamConfig, SamModel, input_size, postprocess_masks
