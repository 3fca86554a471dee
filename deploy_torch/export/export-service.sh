#!/bin/sh
# Port-forward the job gateway to localhost:8099.
kubectl -n foremast port-forward svc/foremast-service 8099:8099
