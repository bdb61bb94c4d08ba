"""Launch entry points of the port (LM serving)."""
