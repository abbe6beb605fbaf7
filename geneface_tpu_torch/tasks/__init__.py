"""Training tasks of the port, resolved from a config's ``task_cls``."""
