package KmerGutsClient;

# JSON-RPC client for the KmerGuts annotation service.
#
# Counterpart of the reference's generated Perl client
# (lib/KmerGutsJava/KmerGutsJavaClient.pm, which exposes only status because
# the KIDL module is empty). Core-module-only (HTTP::Tiny + JSON::PP), and
# also drives the real `annotate` method.
#
# Usage:
#   my $c = KmerGutsClient->new("http://host:5000");
#   my $st = $c->status();
#   my $report = $c->annotate({fasta => ">P1\nACDEF...\n", aa => 1});

use strict;
use warnings;
use HTTP::Tiny;
use JSON::PP;

sub new {
    my ($class, $url, %opts) = @_;
    my $self = {
        url   => $url,
        http  => HTTP::Tiny->new(timeout => $opts{timeout} // 600),
        json  => JSON::PP->new->utf8->allow_nonref,
        token => $opts{token},
        id    => 0,
    };
    return bless $self, $class;
}

sub _call {
    my ($self, $method, $params) = @_;
    my $payload = $self->{json}->encode({
        version => "1.1",
        method  => "KmerGutsJava.$method",
        params  => $params,
        id      => ++$self->{id} . "",
    });
    my %headers = ("Content-Type" => "application/json");
    $headers{Authorization} = $self->{token} if defined $self->{token};
    my $res = $self->{http}->post($self->{url}, {
        content => $payload,
        headers => \%headers,
    });
    die "transport error: $res->{status} $res->{reason}\n"
        unless $res->{content};
    my $body = $self->{json}->decode($res->{content});
    if ($body->{error}) {
        my $e = $body->{error};
        die sprintf("%s (%s): %s\n", $e->{name} // "JSONRPCError",
                    $e->{code} // -32000, $e->{message} // "");
    }
    return $body->{result};
}

sub status {
    my ($self) = @_;
    return $self->_call("status", [])->[0];
}

sub warm {
    my ($self) = @_;
    return $self->_call("warm", [])->[0];
}

sub _coerce_flags {
    my ($opts) = @_;
    # JSON booleans for flag-ish fields
    for my $k (qw(aa order_constraint debug)) {
        $opts->{$k} = $opts->{$k} ? JSON::PP::true : JSON::PP::false
            if exists $opts->{$k};
    }
    return $opts;
}

# $opts: {fasta => ..., aa => 1, min_hits => ..., ...} -> report text
sub annotate {
    my ($self, $opts) = @_;
    return $self->_call("annotate", [_coerce_flags($opts)])->[0]{report};
}

# Async-job protocol, matching the reference's generated Perl client's
# job polling (lib/KmerGutsJava/KmerGutsJavaClient.pm).
sub annotate_submit {
    my ($self, $opts) = @_;
    return $self->_call("_annotate_submit", [_coerce_flags($opts)])->[0];
}

sub check_job {
    my ($self, $job_id) = @_;
    return $self->_call("_check_job", [$job_id])->[0];
}

sub annotate_async {
    my ($self, $opts) = @_;
    my $job_id = $self->annotate_submit($opts);
    my $delay = 0.1;
    while (1) {
        my $job = $self->check_job($job_id);
        if ($job->{finished}) {
            if ($job->{error}) {
                my $e = $job->{error};
                die sprintf("%s (%s): %s\n", $e->{name} // "JSONRPCError",
                            $e->{code} // -32000, $e->{message} // "");
            }
            return $job->{result}[0]{report};
        }
        select(undef, undef, undef, $delay);  # sub-second sleep
        $delay = $delay * 1.5 > 300 ? 300 : $delay * 1.5;
    }
}

1;
