"""The plain reference of the video mask prior: SAM 2.1's video step
(``model.py``, functions of a released-key state dict, the memory bank
chosen and concatenated as upstream's video predictor does) and its key
layout (``shapes.py``), written from the published modules. It imports
nothing of the program."""
