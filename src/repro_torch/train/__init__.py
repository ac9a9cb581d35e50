"""Training substrate (counterpart of ``repro.train``): the AdamW
optimizer, the train-step builder (microbatching, remat), async atomic
checkpointing, the data pipeline and int8 gradient compression. The
reference's elastic mesh recovery needs several devices and is not
ported."""
