"""Signal processing: STFT, log power and the SALSA frequency-compression matrix."""
