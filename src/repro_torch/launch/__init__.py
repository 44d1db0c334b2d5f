"""Launch entry points of the port: the serving demo and the training
driver."""
