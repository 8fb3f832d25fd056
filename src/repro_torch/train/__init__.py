"""Step functions (``train_step``), optimizers, gradient compression and
the trainer of the port."""
