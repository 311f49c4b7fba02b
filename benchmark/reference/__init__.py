"""Plain references the program is held to; they import nothing of it."""
