"""TTS modules of the port."""
