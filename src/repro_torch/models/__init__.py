"""Model substrate of the port: config, parameter schema, layers, stack,
model and the bridge from JAX parameter trees."""
