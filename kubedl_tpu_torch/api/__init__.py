"""The API rules the port's entry points apply to their own configuration."""
