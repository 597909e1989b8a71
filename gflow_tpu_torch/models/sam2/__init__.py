from .model import MemoryBank, Sam2Config, Sam2Model, attended, video_masks
