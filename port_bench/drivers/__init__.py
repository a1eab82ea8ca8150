"""The entry points a cell drives, one module each, found by the name in its workload file."""
