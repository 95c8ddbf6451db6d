"""The port's models: the Inception CNN the paper studies."""
