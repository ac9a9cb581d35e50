"""Continuous-batching serving over a contiguous slot arena or a paged KV
arena (counterpart of ``repro.serve``): kv_slots, kv_pages, scheduler,
dispatch, engine."""
