"""CRNN for SELD in PyTorch: PannResNet22 encoder + recurrent decoder + heads."""
