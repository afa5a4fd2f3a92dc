"""Training entry points: the LM train step through the protocol engine."""
