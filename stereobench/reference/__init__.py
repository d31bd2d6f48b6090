"""The plain reference: ZNCC volumes, the head, the loss, its camera gradient and Adam, in plain PyTorch (nothing of the port)."""
