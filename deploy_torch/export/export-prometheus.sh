#!/bin/sh
# Port-forward Prometheus to localhost:9090.
kubectl -n monitoring port-forward svc/prometheus-k8s 9090:9090
