"""Recognizer training on the card: the trainer loop and its checkpoints."""
