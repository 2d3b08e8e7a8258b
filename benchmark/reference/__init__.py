"""The benchmark's plain reference: the models of its configurations in
plain PyTorch, float32, written from the published descriptions of the
reference implementation (wsntxxn/AudioCaption).  It imports nothing of
the program and nothing of JAX."""
