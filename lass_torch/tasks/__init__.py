"""Training tasks (the AudioSep train step)."""
