"""Plain references the benchmark holds the program against."""
