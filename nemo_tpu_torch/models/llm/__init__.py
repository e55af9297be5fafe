"""LLM models of the PyTorch port (GPT family)."""
