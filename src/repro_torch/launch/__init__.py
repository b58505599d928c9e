"""Entry points of the port (``repro/launch``): ``serve`` (LM token serving)."""
