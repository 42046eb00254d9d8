// Native serial acquisition shim for the mba_tpu real-time subsystem.
//
// Role (SURVEY.md §2.4): the host-side counterpart of the Teensy firmware's
// line protocol "FSR:<v>\nECG:<v>\nGSR:<v>" @115200 baud (reference
// teensy-src/Multimodal_Readout_and_Triggering.ino:40-66). The reference
// parses this protocol in Python at ~360 it/s (reference
// measurements_and_interactive_visuals.py:73-186, :257); this shim moves the
// byte-level work into C++ so the Python sampling loop only polls parsed
// samples from a lock-free ring buffer:
//
//   - parser_create/feed/poll:    line-protocol parser + SPSC ring buffer
//   - serial_open/read/write:     POSIX termios device I/O @ arbitrary baud
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>

#if defined(__unix__) || defined(__APPLE__)
#include <fcntl.h>
#include <termios.h>
#include <unistd.h>
#define MBA_POSIX 1
#endif

extern "C" {

typedef struct {
    double fsr;
    double ecg;
    double gsr;
    double t_mono;       // monotonic receive time (filled by caller clock)
    uint64_t seq;        // sample sequence number
} Sample;

typedef struct Parser {
    // partial-line accumulator
    char line[256];
    int line_len;
    // latest per-channel values (NaN until first seen)
    double cur_fsr, cur_ecg, cur_gsr;
    int have_fsr, have_ecg, have_gsr;
    uint64_t seq;
    // SPSC ring buffer of completed samples
    Sample* ring;
    uint32_t capacity;
    std::atomic<uint64_t> head;  // write index
    std::atomic<uint64_t> tail;  // read index
    uint64_t dropped;
} Parser;

Parser* parser_create(uint32_t capacity) {
    Parser* p = (Parser*)calloc(1, sizeof(Parser));
    if (!p) return nullptr;
    p->ring = (Sample*)calloc(capacity, sizeof(Sample));
    if (!p->ring) { free(p); return nullptr; }
    p->capacity = capacity;
    p->cur_fsr = p->cur_ecg = p->cur_gsr = 0.0 / 0.0;  // NaN
    return p;
}

void parser_destroy(Parser* p) {
    if (!p) return;
    free(p->ring);
    free(p);
}

static void parser_emit(Parser* p, double t_mono) {
    uint64_t head = p->head.load(std::memory_order_relaxed);
    uint64_t tail = p->tail.load(std::memory_order_acquire);
    if (head - tail >= p->capacity) {
        // ring full: drop oldest (advance tail) — real-time freshness wins
        p->tail.store(tail + 1, std::memory_order_release);
        p->dropped++;
    }
    Sample* s = &p->ring[head % p->capacity];
    s->fsr = p->cur_fsr;
    s->ecg = p->cur_ecg;
    s->gsr = p->cur_gsr;
    s->t_mono = t_mono;
    s->seq = p->seq++;
    p->head.store(head + 1, std::memory_order_release);
}

static void parser_line(Parser* p, const char* line, double t_mono) {
    // grammar: "FSR:<float>" | "ECG:<float>" | "GSR:<float>"
    // a sample completes when all three channels have reported since the
    // last emit; the firmware sends them in FSR,ECG,GSR order each cycle
    double value;
    if (strncmp(line, "FSR:", 4) == 0 && sscanf(line + 4, "%lf", &value) == 1) {
        p->cur_fsr = value;
        p->have_fsr = 1;
    } else if (strncmp(line, "ECG:", 4) == 0 && sscanf(line + 4, "%lf", &value) == 1) {
        p->cur_ecg = value;
        p->have_ecg = 1;
    } else if (strncmp(line, "GSR:", 4) == 0 && sscanf(line + 4, "%lf", &value) == 1) {
        p->cur_gsr = value;
        p->have_gsr = 1;
    } else {
        return;  // malformed line: keep last valid values (reference :120-150)
    }
    if (p->have_fsr && p->have_ecg && p->have_gsr) {
        parser_emit(p, t_mono);
        p->have_fsr = p->have_ecg = p->have_gsr = 0;
    }
}

// Feed raw bytes; returns number of samples completed during this feed.
uint64_t parser_feed(Parser* p, const uint8_t* data, uint32_t n,
                     double t_mono) {
    uint64_t before = p->head.load(std::memory_order_relaxed);
    for (uint32_t i = 0; i < n; ++i) {
        char c = (char)data[i];
        if (c == '\n' || c == '\r') {
            if (p->line_len > 0) {
                p->line[p->line_len] = '\0';
                parser_line(p, p->line, t_mono);
                p->line_len = 0;
            }
        } else if (p->line_len < (int)sizeof(p->line) - 1) {
            p->line[p->line_len++] = c;
        } else {
            p->line_len = 0;  // overlong garbage line: reset
        }
    }
    return p->head.load(std::memory_order_relaxed) - before;
}

// Pop up to max_out samples into out; returns count popped.
uint32_t parser_poll(Parser* p, Sample* out, uint32_t max_out) {
    uint64_t tail = p->tail.load(std::memory_order_relaxed);
    uint64_t head = p->head.load(std::memory_order_acquire);
    uint32_t n = 0;
    while (tail < head && n < max_out) {
        out[n++] = p->ring[tail % p->capacity];
        tail++;
    }
    p->tail.store(tail, std::memory_order_release);
    return n;
}

uint64_t parser_dropped(Parser* p) { return p->dropped; }
uint64_t parser_pending(Parser* p) {
    return p->head.load(std::memory_order_acquire)
         - p->tail.load(std::memory_order_acquire);
}

// ── POSIX serial device I/O ────────────────────────────────────────────
#ifdef MBA_POSIX
int serial_open(const char* path, int baud) {
    int fd = open(path, O_RDWR | O_NOCTTY | O_NONBLOCK);
    if (fd < 0) return -errno;
    struct termios tio;
    if (tcgetattr(fd, &tio) != 0) { close(fd); return -errno; }
    cfmakeraw(&tio);
    speed_t speed = B115200;
    switch (baud) {
        case 9600: speed = B9600; break;
        case 57600: speed = B57600; break;
        case 115200: speed = B115200; break;
        case 230400: speed = B230400; break;
        default: break;
    }
    cfsetispeed(&tio, speed);
    cfsetospeed(&tio, speed);
    tio.c_cc[VMIN] = 0;
    tio.c_cc[VTIME] = 0;
    if (tcsetattr(fd, TCSANOW, &tio) != 0) { close(fd); return -errno; }
    return fd;
}

int serial_read_into_parser(int fd, Parser* p, double t_mono) {
    uint8_t buf[4096];
    ssize_t n = read(fd, buf, sizeof(buf));
    if (n <= 0) return (int)n;
    return (int)parser_feed(p, buf, (uint32_t)n, t_mono);
}

int serial_write_byte(int fd, uint8_t byte) {
    return (int)write(fd, &byte, 1);
}

int serial_close(int fd) { return close(fd); }
#endif

}  // extern "C"
