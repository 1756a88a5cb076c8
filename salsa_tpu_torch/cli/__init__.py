"""Command-line entry points: batch serving (`predict`) and scoring (`evaluate`)."""
