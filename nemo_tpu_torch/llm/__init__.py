"""LLM tools of the PyTorch port."""
