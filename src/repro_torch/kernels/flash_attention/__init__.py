"""GQA attention forward: the hand-written CUDA flash kernel, its plain
version, the exact-softmax oracle and the chunked online-softmax path."""
