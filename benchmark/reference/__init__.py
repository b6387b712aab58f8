"""The plain reference the benchmark judges the port against.

Plain PyTorch in float32 (TF32 off), written from the game's and the
policy's rules, with no kernel, no cache and no batching trick. Nothing here
imports the measured package or JAX: it takes the inputs the benchmark made
(the seed, the weights it drew, the traffic) and works out again what the
port derived from them. The port's outputs are read only to be judged.
"""
