"""One module a configuration: what the benchmark drives of the measured
package. Each builds the system under test from the configuration and a
cell's load, solves a request, and names the wrappers whose launch
counters it reads."""
