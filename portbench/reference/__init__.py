"""The plain reference: the same scenes rendered by a path tracer written
in plain PyTorch and numpy from the configuration data alone. It imports
nothing of the program under test."""
