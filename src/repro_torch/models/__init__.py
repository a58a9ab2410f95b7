"""Models of the port: layers, GQA attention, decoder blocks and the
language model, with weight carry-over from the JAX package."""
