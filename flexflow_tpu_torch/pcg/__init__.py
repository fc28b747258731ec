"""PCG IR: shapes and the graph."""
