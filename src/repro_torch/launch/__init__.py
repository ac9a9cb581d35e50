"""Entry points (counterpart of ``repro.launch``): serve.py."""
