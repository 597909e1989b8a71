"""The plain reference of the prior preparation: a frozen copy of the
port's models at the commit that defined the benchmark (GMFlow
``models/unimatch/gmflow.py``, MASt3R ``models/mast3r/vit.py`` and
``dpt_head.py``, ``models/precision.py``, the global alignment
``models/mast3r/alignment.py`` run eagerly through ``_eager``), and the
stages' host arithmetic (``pipeline.py``). It imports nothing of the
program."""
