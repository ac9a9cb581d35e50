"""Training substrate (counterpart of ``repro.train``): the AdamW
optimizer, the train-step builder (microbatching, remat), async atomic
checkpointing, the data pipeline, int8 gradient compression (with its
all-reduce over a mesh axis) and elastic mesh shapes."""
