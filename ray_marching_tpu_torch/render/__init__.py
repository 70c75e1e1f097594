"""Renderer, shaders and render configuration."""
