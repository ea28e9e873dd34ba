"""The 95th percentile of request latency in ms, over every request of the
window: from the call to its synchronized response."""
import statistics


def read(rec: dict):
    lat = rec["latencies_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
