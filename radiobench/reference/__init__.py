"""Plain references, one a configuration; they import nothing of the port."""
