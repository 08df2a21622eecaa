"""Training data path of the port: augmentations on the device and the batch generator."""
