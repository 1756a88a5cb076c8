"""SALSA feature extraction: noise-floor tracker (K2), spatial stage (K1), registry."""
