"""Traffic loops of the benchmark, one module a kind of work; a traffic
file names its driver and gives its parameters."""
