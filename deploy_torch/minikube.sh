#!/bin/sh
# Local demo cluster (reference deploy/minikube.sh footprint: 4 CPU / 6 GB).
minikube start --cpus 4 --memory 6144
minikube addons enable ingress
