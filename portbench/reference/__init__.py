"""The benchmark's plain PyTorch reference: no import of the program."""
