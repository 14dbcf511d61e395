"""The dense decoder of the LLM stack: layers and model assembly."""
