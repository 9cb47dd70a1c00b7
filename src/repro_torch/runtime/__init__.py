"""Training runtime on one device: the train step and fault tolerance."""
