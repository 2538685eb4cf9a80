"""The serving front end: bucketed batching and staging, the micro-batching
dispatcher, the SLO layer and the open-loop load generator."""
