"""Continuous-batching serving over a paged KV arena (counterpart of
``repro.serve``): kv_pages, scheduler, dispatch, engine."""
