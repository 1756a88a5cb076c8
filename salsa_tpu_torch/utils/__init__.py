"""Config reading, the experiment tree and WAV I/O, without yaml."""
