"""Plain PyTorch references of the configurations, in float32.  They import
nothing of the program: each works out what the program derives (quantized
weights, states) again from the weights the benchmark makes."""
