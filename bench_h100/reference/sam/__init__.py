"""The plain reference of the mask prior: Segment Anything's forward
(``model.py``, functions of a released-key state dict), its key layout
(``shapes.py``) and the automatic mask generator's semantics with
GFlow's union (``generator.py``), written from the published
description. It imports nothing of the program."""
