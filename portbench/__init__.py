"""The benchmark of the PyTorch port (``tml_image_editing_defense_torch``):
``python3 -m portbench.run``; see ``portbench/run.py``."""
