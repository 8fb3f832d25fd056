"""Step functions of the port.  The serving steps are here; the training
steps come with the training slice."""
