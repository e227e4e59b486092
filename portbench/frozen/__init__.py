"""Arithmetic of the yardstick that later changes may not edit."""
