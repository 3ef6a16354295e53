PYTHON ?= python

.PHONY: test lint bench native native-test clean

test:
	$(PYTHON) -m pytest tests/ -q

lint:
	$(PYTHON) -m flake8 graphdot_tpu/ tests/ --max-line-length=79 \
	    --extend-ignore=E203,W503 || true

bench:
	$(PYTHON) bench.py

# builds graphdot_tpu/native/_packer-<hash>.so (also done on first use)
native:
	$(PYTHON) -c "from graphdot_tpu import native; assert native.available()"

native-test:
	g++ -O2 -o /tmp/graphdot_tpu_test_packer \
	    graphdot_tpu/native/test_packer.cpp \
	    graphdot_tpu/native/packer.cpp
	/tmp/graphdot_tpu_test_packer

clean:
	rm -f graphdot_tpu/native/_packer*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
