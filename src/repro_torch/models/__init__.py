"""Model families of the port (dense so far) and their building blocks."""
