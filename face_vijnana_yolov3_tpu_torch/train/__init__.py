"""Training: the Keras-semantics Adam and the detector trainer."""
