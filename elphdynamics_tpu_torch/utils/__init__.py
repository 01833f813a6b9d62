"""Small utilities shared by the port (accurate reductions, noise)."""
