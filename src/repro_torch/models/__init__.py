"""The port's models: the Inception CNN the paper studies and the MoE
language model whose experts are its independent branches."""
